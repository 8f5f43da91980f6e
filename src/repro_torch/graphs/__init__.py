"""Seeded synthetic graph generators (numpy)."""
