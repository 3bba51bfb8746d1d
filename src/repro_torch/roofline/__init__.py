"""Roofline and dry-run analysis on the card's terms (the port of
``repro.roofline``): the analytic model, the collective and op census,
the layer-period and sync probes, and the reports."""
