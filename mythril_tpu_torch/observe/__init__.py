"""Observability constants the port's solver reports with."""
