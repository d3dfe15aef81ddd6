"""Example drivers of the port, each run as a module, e.g.
``python -m galerkin_transformer_torch.examples.ex1_burgers``."""
