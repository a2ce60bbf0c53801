"""Device-side input preprocessing."""
