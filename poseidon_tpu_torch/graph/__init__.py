"""Cluster state, EC collapse, and the round planner (torch port)."""
