"""Manual model parallelism (``group2ctx``) examples."""
