"""Traffic generators, one module a kind of traffic."""
