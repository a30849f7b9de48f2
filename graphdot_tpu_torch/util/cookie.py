"""Volatile per-object cache (reference: ``graphdot/util/cookie.py``).

Graphs carry a cookie dict used to cache their padded array
representation; the cookie is intentionally dropped on pickle/deepcopy so
stale device buffers never escape a process.
"""


class VolatileCookie(dict):

    def __reduce__(self):
        return (VolatileCookie.__new__, (VolatileCookie,))

    def __deepcopy__(self, memo):
        """Deep copy of a volatile cookie is intentionally nullified."""
        return type(self)()
