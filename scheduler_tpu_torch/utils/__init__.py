"""Infra utilities: assertions, priority queue, env flags, metrics, phases."""
