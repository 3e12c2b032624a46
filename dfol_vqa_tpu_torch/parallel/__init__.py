"""Device mesh: the data and model axes and FSDP, one process per device."""
