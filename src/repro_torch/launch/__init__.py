"""Launchers of the port: the serve entry point (``serve``).  The mesh,
spec, dry-run and train launchers come with later LM slices."""
