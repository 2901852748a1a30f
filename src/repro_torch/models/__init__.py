"""Model zoo slice: attention + dense-FFN decoders."""
