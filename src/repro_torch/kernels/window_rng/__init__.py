"""A window's random draw table in one kernel."""
