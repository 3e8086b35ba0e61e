"""Test helpers."""
