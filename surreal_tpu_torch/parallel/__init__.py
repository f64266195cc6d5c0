"""Versioned actor-parameter snapshots (single device)."""
