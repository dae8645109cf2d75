"""Periodic table basics (a copy of pyqmc_tpu/system/elements.py)."""

SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
]

CHARGE = {s: i for i, s in enumerate(SYMBOLS)}


def atomic_number(symbol: str) -> int:
    s = symbol.strip()
    s = s[0].upper() + s[1:].lower() if len(s) > 1 else s.upper()
    return CHARGE[s]
