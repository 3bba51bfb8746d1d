"""Training statistics, the comms ledger and the metrics registry (the
port of ``repro.telemetry.stats``, ``ledger`` and ``metrics``)."""
