"""stats — the per-holder health scoreboard the remote readers feed, and
the master's repair queue."""
