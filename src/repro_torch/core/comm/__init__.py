"""Communication layer: table collectives over the workers of one card or of a process group."""
