"""Host-side pipeline: ROI discovery, bucketing and the pair runner."""
