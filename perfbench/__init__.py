"""The port's benchmark: see PERF.md at the root of the repository."""
