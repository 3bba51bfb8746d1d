"""Checkpoints in the reference's npz format: per-leaf and flat-bus
snapshots, the elastic worker-axis restore and the versioned publish
channel of the serving hot-swap (:mod:`repro_torch.checkpoint.checkpoint`)."""
