"""Stage checkpoints and config files of the port."""
