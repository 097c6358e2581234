"""Hardware frontends: AprilTag detections as landmark measurements."""
