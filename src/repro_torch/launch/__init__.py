"""Launch-time analysis on one card: the launch grid's shapes, the H100
roofline, the op-level cost counter, the meta-device dry run of every
architecture x shape, and the paper's join at P = 8 (``dryrun_ddf``)."""
