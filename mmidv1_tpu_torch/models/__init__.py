"""The age-structured SEPAIHRD model, the SIR family, interventions and the
result CSVs."""

from . import sepaihrd, sir, results, interventions

__all__ = ["sepaihrd", "sir", "results", "interventions"]
