"""Input preprocessing: salient-object matting (U2Net)."""
