"""Input makers and call runners, one a configuration kind."""
