"""Device layouts for the entry points (twin of ``repro/launch``)."""
