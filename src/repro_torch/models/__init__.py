"""Model code of the port: layers, attention, the transformer backbone."""
