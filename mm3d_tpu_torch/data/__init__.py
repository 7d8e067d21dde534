"""Data layer of the port: synthetic datasets, augmentation, input pipeline."""
