"""Cached file download helper; a copy of ``graphdot_tpu/dataset/_get.py``
(the role of the reference's ``graphdot/dataset/_get.py:7``).

``requests`` is imported only when the file has to be fetched: a file that
exists is returned untouched, with no network access.
"""
import os


def get(url, local_filename, overwrite=False, parser=None):
    """Fetch ``url`` into ``local_filename`` unless it already exists;
    optionally run ``parser`` on the local path and return its result."""
    missing = not os.path.exists(local_filename)
    if missing or overwrite:
        import requests
        response = requests.get(url)
        if response.status_code != 200:
            raise RuntimeError(
                f'Downloading from {url} failed with HTTP status '
                f'code {response.status_code}.'
            )
        with open(local_filename, 'wb') as f:
            f.write(response.content)
    return parser(local_filename) if parser is not None else local_filename
