"""Replay: the on-device ring buffer and its n-step sampling."""
