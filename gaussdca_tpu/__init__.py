"""Gaussian Direct Coupling Analysis on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
carlobaldassi/GaussDCA.jl (protein contact prediction from multiple
sequence alignments). See SURVEY.md at the repo root for the structural
map of the reference and how each layer is realized here.
"""

from gaussdca_tpu.api import GDCAConfig, GDCAResult, gdca, gdca_from_msa, printrank

# Drop-in spelling for users coming from the reference (exports `gDCA`,
# /root/reference/src/GaussDCA.jl:3).
gDCA = gdca

__version__ = "0.2.0"

__all__ = [
    "gdca",
    "gDCA",
    "gdca_from_msa",
    "printrank",
    "GDCAConfig",
    "GDCAResult",
    "__version__",
]
