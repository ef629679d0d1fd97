"""Scheduler policies of the serving front door (the HTTP server is
not ported yet: ROADMAP.md A7)."""
