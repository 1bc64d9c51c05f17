"""The block axis split over several devices (sharding) and over several
processes (distributed)."""
