"""Embedding space, row-sharded bag forward, interaction and the DLRM forward."""
