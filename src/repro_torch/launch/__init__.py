"""Entry points that build the LM's serving steps (``launch.steps``)."""
