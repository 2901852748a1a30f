"""TT algebra and the MetaTT adapter."""
