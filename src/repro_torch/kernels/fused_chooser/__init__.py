"""Fused mixed-window chooser: a whole window's slot loop in one kernel."""
