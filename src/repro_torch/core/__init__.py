"""Local SGD core: flat bus, schedules, compression, sync plan."""
