"""TUNER benchmark schema and query templates (paper Section V), with
the reference's numpy RNG streams."""
