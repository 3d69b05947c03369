"""Serving runtime of the port: paged KV pool, servable model, engine."""
