"""Host-side input preprocessing of the port."""
