"""Transaction drivers; the port holds only `symbolic.Actors`."""
