"""Serving of the port: the clients, the Haar face detector and the HTTP
server (``python -m twingan_tpu_torch.serve.server``)."""
