"""The benchmark of reduced3dgs_torch: seeded published-size scenes
trained and viewed on the card, judged against plain references.  Run
as ``python3 -m splatbench.run`` (see run.py)."""
