"""Distributed helpers the port needs so far (the data resume layout)."""
