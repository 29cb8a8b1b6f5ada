"""Device-parallel local training (the loop and bucketed tiers)."""
