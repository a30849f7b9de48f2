from .m3 import M3

__all__ = ['M3']
