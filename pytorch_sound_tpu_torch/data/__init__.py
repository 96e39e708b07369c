"""The data layer: text frontends, dataset metas and the speech loaders."""
