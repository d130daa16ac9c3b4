"""Safe memory reclamation schemes (paper §2.2, §5)."""

from .base import BatchGuard, Guard, SmrScheme, ThreadCtx
from .ebr import EBR
from .he import HE
from .hp import HP
from .hyaline import Hyaline1S
from .ibr import IBR
from .nr import NR
from .vbr import VBR

SCHEMES = {
    "NR": NR,
    "EBR": EBR,
    "HP": HP,
    "HE": HE,
    "IBR": IBR,
    "HLN": Hyaline1S,
    "VBR": VBR,
}


def make_scheme(name: str, **kwargs) -> SmrScheme:
    try:
        cls = SCHEMES[name.upper()]
    except KeyError:
        raise ValueError(f"unknown SMR scheme {name!r}; choose from {sorted(SCHEMES)}")
    return cls(**kwargs)


__all__ = [
    "BatchGuard",
    "Guard",
    "SmrScheme",
    "ThreadCtx",
    "NR",
    "EBR",
    "HP",
    "HE",
    "IBR",
    "VBR",
    "Hyaline1S",
    "SCHEMES",
    "make_scheme",
]
