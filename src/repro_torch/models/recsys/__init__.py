"""The recsys funnel's models: two-tower retrieval (stage 1), BST
(stage 2) and the embedding tables with their bag reduce."""
