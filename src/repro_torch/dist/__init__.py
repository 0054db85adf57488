"""The collectives of the hybrid step and their configuration (twin of
``repro/dist/``)."""
