"""The age-structured SEPAIHRD model."""
