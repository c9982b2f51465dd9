"""Backup and restore agents."""

from .agent import BackupAgent, BackupManifest, RestoreError
from .container import BackupContainer, ContainerError

__all__ = ["BackupAgent", "BackupManifest", "RestoreError",
           "BackupContainer", "ContainerError"]
