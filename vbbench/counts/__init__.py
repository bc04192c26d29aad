"""Frozen work counts and peaks."""
