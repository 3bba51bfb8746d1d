"""Training statistics, the comms ledger, the metrics registry, the trace
spine and its exporters (the port of ``repro.telemetry.stats``,
``ledger``, ``metrics``, ``trace`` and ``export``)."""
