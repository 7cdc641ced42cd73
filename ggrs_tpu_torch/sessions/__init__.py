"""Host sessions that emit Save/Load/Advance requests for a rollback backend."""
