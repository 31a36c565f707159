"""Distributed execution (only ``courier.CourierClosed`` is ported yet)."""
