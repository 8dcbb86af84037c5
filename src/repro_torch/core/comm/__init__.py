"""Communication layer: table collectives over the workers of one card."""
