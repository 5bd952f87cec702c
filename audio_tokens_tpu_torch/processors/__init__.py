"""Pipeline stages of the port; so far stage 4, ``ModelTrainer``."""
