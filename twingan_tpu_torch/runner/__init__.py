"""The progressive-growth stage runner, its CLI, checkpoints, migration and
config files."""
