"""The port's storage engine, planner, executor and tuner (plain
tables).  Import names from the modules or from ``repro_torch.api``."""
