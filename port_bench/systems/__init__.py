"""Adapters from a configuration to the program under test: each
``systems/<system>.py`` builds the program's own train step for the
configuration's widths and starts it from the benchmark's weights."""
