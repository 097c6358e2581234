"""The viewer: matplotlib artists, the live viewer and the async frame feed."""
