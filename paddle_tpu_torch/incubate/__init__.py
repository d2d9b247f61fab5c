"""Incubating APIs of the PyTorch port."""
