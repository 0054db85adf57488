"""Synthetic inputs and the threaded host iterator."""
