"""METLIN-SMRT dataset loader; a copy of
``graphdot_tpu/dataset/metlin_smrt.py``.

The reference's ``graphdot/dataset/__init__.py`` imports this module but
the file is absent from its checkout; the JAX package reconstructed the
loader from the published dataset: the METLIN small-molecule
retention-time dataset (Domingo-Almenara et al., Nature Communications
2019), distributed as a CSV of PubChem CID / SMILES / retention time. What
differs from the JAX module: ``pandas`` is imported when the loader runs,
not when the module is imported.
"""
from ._get import get


def METLIN_SMRT(
    download_url='https://ndownloader.figshare.com/files/18130628',
    local_filename='SMRT_dataset.csv', overwrite=False
):
    """The METLIN small-molecule retention time (SMRT) dataset: ~80k
    molecules with experimental HPLC retention times.

    Returns
    -------
    pandas.DataFrame with at least 'pubchem', 'inchi' (or 'smiles'), and
    'rt' columns as distributed: the file is read with ';' as its
    separator, and with ',' when that gives one column.
    """
    import pandas as pd
    f = get(download_url, local_filename, overwrite=overwrite)
    try:
        df = pd.read_csv(f, sep=';')
        if df.shape[1] == 1:
            df = pd.read_csv(f)
    except Exception as e:
        raise RuntimeError(
            f'Loading {local_filename} failed due to error: {e}.'
        )
    return df
