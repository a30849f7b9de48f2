"""Built-in element length-scale tables (picometers); a copy of
``graphdot_tpu/graph/adjacency/_ptable.py``.

Standard public values (van der Waals radii after Bondi 1964 / Alvarez
2013, covalent radii after Cordero 2008 / Pyykko 2009, atomic radii after
Slater 1964) for the chemically common elements, indexed by atomic number
(index 0 unused). Elements not listed fall back to 200 pm (vdw) / 150 pm
(covalent/atomic), which only matters for exotic elements far outside the
supported datasets (QM7/QM9 molecules contain H, C, N, O, S, F only).

What differs from the original: only the built-in tables. A table name
outside them raises the ``ValueError`` that the JAX module raises when the
optional ``mendeleev`` package is missing; the port never imports it.
"""
import numpy as np

_MAX_Z = 118

# van der Waals radii, pm. Bondi (1964) for main-group; Alvarez (2013) for
# transition metals and lanthanides where Bondi gives no value.
_VDW = {
    1: 120, 2: 140, 3: 181, 4: 198, 5: 192, 6: 170, 7: 155, 8: 152,
    9: 147, 10: 154, 11: 227, 12: 173, 13: 184, 14: 210, 15: 180, 16: 180,
    17: 175, 18: 188, 19: 275, 20: 231, 21: 258, 22: 246, 23: 242, 24: 245,
    25: 245, 26: 244, 27: 240, 28: 163, 29: 140, 30: 139, 31: 187, 32: 211,
    33: 185, 34: 190, 35: 185, 36: 202, 37: 303, 38: 249, 39: 275, 40: 252,
    41: 256, 42: 245, 43: 244, 44: 246, 45: 244, 46: 163, 47: 172, 48: 158,
    49: 193, 50: 217, 51: 206, 52: 206, 53: 198, 54: 216, 55: 343, 56: 268,
    57: 298, 58: 288, 59: 292, 60: 295, 62: 290, 63: 287, 64: 283, 65: 279,
    66: 287, 67: 281, 68: 283, 69: 279, 70: 280, 71: 274, 72: 263, 73: 253,
    74: 257, 75: 249, 76: 248, 77: 241, 78: 175, 79: 166, 80: 155, 81: 196,
    82: 202, 83: 207, 84: 197, 85: 202, 86: 220, 87: 348, 88: 283, 92: 186,
}

# Covalent radii, pm (Cordero et al. 2008).
_COVALENT = {
    1: 31, 2: 28, 3: 128, 4: 96, 5: 84, 6: 76, 7: 71, 8: 66, 9: 57,
    10: 58, 11: 166, 12: 141, 13: 121, 14: 111, 15: 107, 16: 105, 17: 102,
    18: 106, 19: 203, 20: 176, 21: 170, 22: 160, 23: 153, 24: 139, 25: 139,
    26: 132, 27: 126, 28: 124, 29: 132, 30: 122, 31: 122, 32: 120, 33: 119,
    34: 120, 35: 120, 36: 116, 37: 220, 38: 195, 39: 190, 40: 175, 41: 164,
    42: 154, 43: 147, 44: 146, 45: 142, 46: 139, 47: 145, 48: 144, 49: 142,
    50: 139, 51: 139, 52: 138, 53: 139, 54: 140, 55: 244, 56: 215, 57: 207,
    72: 175, 73: 170, 74: 162, 75: 151, 76: 144, 77: 141, 78: 136, 79: 136,
    80: 132, 81: 145, 82: 146, 83: 148, 84: 140, 85: 150, 86: 150, 92: 196,
}

# Empirical atomic radii, pm (Slater 1964).
_ATOMIC = {
    1: 25, 2: 120, 3: 145, 4: 105, 5: 85, 6: 70, 7: 65, 8: 60, 9: 50,
    10: 160, 11: 180, 12: 150, 13: 125, 14: 110, 15: 100, 16: 100, 17: 100,
    18: 71, 19: 220, 20: 180, 21: 160, 22: 140, 23: 135, 24: 140, 25: 140,
    26: 140, 27: 135, 28: 135, 29: 135, 30: 135, 31: 130, 32: 125, 33: 115,
    34: 115, 35: 115, 36: 88, 37: 235, 38: 200, 39: 180, 40: 155, 41: 145,
    42: 145, 43: 135, 44: 130, 45: 135, 46: 140, 47: 160, 48: 155, 49: 155,
    50: 145, 51: 145, 52: 140, 53: 140, 54: 108, 55: 260, 56: 215, 78: 135,
    79: 135, 80: 150, 81: 190, 82: 180, 83: 160, 92: 175,
}

_BUILTIN = {
    'vdw_radius': (_VDW, 200.0),
    'atomic_radius': (_ATOMIC, 150.0),
    'covalent_radius': (_COVALENT, 150.0),
    'covalent_radius_cordero': (_COVALENT, 150.0),
    'covalent_radius_pyykko': (_COVALENT, 150.0),
}


def get_length_scales(name):
    """Per-element length scales in Angstrom, indexed by atomic number.

    Returns an array where entry Z holds the length scale of element Z in
    Angstrom; raises ValueError for a table that is not built in.
    """
    if name in _BUILTIN:
        table, default = _BUILTIN[name]
        length = np.full(_MAX_Z + 1, default)
        for z, v in table.items():
            length[z] = v
        return length * 0.01  # pm to Angstrom
    raise ValueError(
        f'Unknown length-scale table {name!r}; built-in tables are '
        f'{sorted(_BUILTIN)} and others require the optional mendeleev '
        'package.'
    )
