"""Dataset construction: keyframes, dedup, masks, inpainting, alignment
and captions (the StorySalon build, scripts/build_dataset.py)."""
