"""The ported jobs."""
