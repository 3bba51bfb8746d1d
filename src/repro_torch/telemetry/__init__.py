"""Training statistics and the comms ledger (the port of
``repro.telemetry.stats`` and ``repro.telemetry.ledger``)."""
