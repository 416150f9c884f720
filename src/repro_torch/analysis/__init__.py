"""Analytic FLOP / byte models.  ``hlo`` and ``roofline`` wait for the
mesh slice (ROADMAP.md §1 item 14)."""
