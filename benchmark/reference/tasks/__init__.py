"""One reference module per task, found by the configuration's `task`."""
