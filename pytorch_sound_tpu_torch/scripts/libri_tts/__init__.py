"""LibriTTS restructuring helpers."""
