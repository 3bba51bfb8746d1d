"""Worker layouts across processes (the data-parallel part of the port of
``repro.sharding``)."""
