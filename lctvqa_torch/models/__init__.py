"""The W and EF models (fixed VGG19 encoder)."""
