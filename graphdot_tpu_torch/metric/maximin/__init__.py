from ._maximin import MaxiMin

__all__ = ['MaxiMin']
