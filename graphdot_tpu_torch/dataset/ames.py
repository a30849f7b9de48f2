"""AMES mutagenicity dataset loader; a copy of
``graphdot_tpu/dataset/ames.py``.

As with METLIN_SMRT, the reference advertises this loader but the file is
missing from its checkout; the JAX package reconstructed it as a CSV loader
for the Hansen et al. (2009) Ames mutagenicity benchmark (SMILES + binary
mutagenicity labels). What differs from the JAX module: ``pandas`` is
imported when the loader runs, not when the module is imported.
"""
from ._get import get


def AMES(
    download_url=(
        'https://doc.ml.tu-berlin.de/toxbenchmark/'
        'Mutagenicity_N6512.csv'
    ),
    local_filename='ames.csv', overwrite=False
):
    """Ames bacterial mutagenicity benchmark (~6.5k molecules).

    Returns
    -------
    pandas.DataFrame with SMILES strings and mutagenicity labels as
    distributed.
    """
    import pandas as pd
    f = get(download_url, local_filename, overwrite=overwrite)
    try:
        df = pd.read_csv(f)
    except Exception as e:
        raise RuntimeError(
            f'Loading {local_filename} failed due to error: {e}.'
        )
    return df
