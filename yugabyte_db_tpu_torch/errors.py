"""Typed refusals shared by every layer of the port."""
from __future__ import annotations


class NotPortedError(NotImplementedError):
    """A shape the port does not run yet; the message names the
    ROADMAP.md item that will port it."""

    def __init__(self, what: str, roadmap_item: str):
        super().__init__(f"{what} is not ported yet (ROADMAP.md: "
                         f"{roadmap_item})")
        self.roadmap_item = roadmap_item
