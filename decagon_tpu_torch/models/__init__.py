"""Encoder, decoders and the model facade."""
