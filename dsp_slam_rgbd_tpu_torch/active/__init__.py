"""Active mapping: next-best-view scoring and RRT path planning."""
