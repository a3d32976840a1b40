"""Bytecode helpers."""
