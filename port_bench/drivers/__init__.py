"""One driver per kind of traffic, found by the name a cell's file gives."""
