"""Evaluation: CLIP-I / CLIP-T / PickScore on the port's own CLIP towers
(clip_scores.py, preprocess.py) and the Frechet distance (fid.py)."""
