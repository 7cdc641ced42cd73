"""Device games (ex_game, arena, swarm)."""
