"""KNN probe of the pretrained features (port of the JAX package's
``ops/knn.py``): scikit-learn's ``KNeighborsClassifier`` defaults, written
in torch so that it runs on the features' device. k = 5 neighbours by
euclidean distance, a uniform vote, ties between classes to the smallest
class."""

import torch


K = 5  # neighbours
CHUNK = 4096  # queries a distance matrix holds, so it stays CHUNK x n


class KNN:
    """fit(features [n, d], labels [n]) then predict(features [q, d]) ->
    int64 labels [q], on the device of the fitted features."""

    def fit(self, features, labels):
        self.fit_x = torch.as_tensor(features, dtype=torch.float32)
        self.fit_y = torch.as_tensor(labels, dtype=torch.int64, device=self.fit_x.device)
        self.num_classes = int(self.fit_y.max()) + 1
        self.sq = self.fit_x.square().sum(1)
        return self

    def predict(self, features):
        q = torch.as_tensor(features, dtype=torch.float32, device=self.fit_x.device)
        k = min(K, self.fit_x.shape[0])
        out = []
        for part in q.split(CHUNK):
            d2 = part.square().sum(1, keepdim=True) + self.sq[None] - 2.0 * part @ self.fit_x.T
            nbr = d2.topk(k, dim=1, largest=False).indices
            votes = torch.zeros(part.shape[0], self.num_classes, device=q.device)
            votes.scatter_add_(1, self.fit_y[nbr], torch.ones(nbr.shape, device=q.device))
            out.append(votes.argmax(1))  # the first maximum: the smallest class
        return torch.cat(out)
