"""The harness: one general driver per kind of traffic, and the yardstick."""
