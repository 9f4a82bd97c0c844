"""Image ops: tracking masks, SSIM, LPIPS, k-NN distances, undistortion,
``jax.image.resize``'s resampling (``resize``), and the monocular depth
priors of few-shot training (``dpt``: DPT_Hybrid, ``midas``: MiDaS v2.1)."""
