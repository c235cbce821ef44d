"""stats — the per-holder health scoreboard the remote readers feed."""
