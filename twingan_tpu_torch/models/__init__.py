"""Model configuration, layers and the PGGAN encoder/generator of the port."""
