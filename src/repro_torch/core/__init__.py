"""Planner core of the port: expert layout, plan solve, balancer modes."""
