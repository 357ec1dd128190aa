"""User-facing model facades of the port."""
