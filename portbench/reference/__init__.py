"""The benchmark's plain reference: Gaussian splat rendering, the L1 + SSIM
loss and the AdamScaled step in plain PyTorch, written from the published
method (3DGS with Brush's projection gates, tile test and blending rules).

It imports nothing of the program under test. It is run once a window has
closed, to judge what the program produced, and in set-up to make the
inputs both sides are handed (ground-truth images).
"""
