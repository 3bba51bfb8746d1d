"""On-device training statistics (the port of ``repro.telemetry.stats``)."""
