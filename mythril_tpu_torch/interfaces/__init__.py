"""The command line (cli.py)."""
