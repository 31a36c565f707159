"""Courier errors.

Holds only ``CourierClosed`` for now, which the batching server raises once
it is stopped; the RPC transport of ``repro/distributed/courier.py`` comes
with the distributed slice.
"""


class CourierClosed(ConnectionError):
    """The peer closed the connection (server stopped, or vice versa)."""
